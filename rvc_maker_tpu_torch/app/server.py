"""Web UI and JSON API of the PyTorch port (counterpart of JAX `app/server.py`).

A stdlib http.server app: the single page and the JSON API of the JAX
package's server (audio as base64 WAV), with the pipelines in process and
the model resident between requests.  Conversion runs on `--device`
(the card unless the caller asks for the CPU) in the precision the
settings choose, bf16 by default (`ConvertPipeline(compute_dtype=...)`).

Routes: GET `/`, `/api/i18n`; POST `/api/convert` (one request at a
time, or the dynamic batcher `app/batcher.py` under
RVC_TPU_BATCH_SERVE=1; 503 and a retry while a train job runs, unless
RVC_TPU_SERVE_DURING_TRAIN=1), `/api/f0_extract` (yin, pyin, swipe, pm,
dio, harvest), `/api/job_start` and `/api/job_status` (preprocess,
extract, train, create_dataset), `/api/settings`, `/api/effects`, `/api/model_info`,
`/api/fuse`, `/api/export_onnx` (host work, in the handler thread: the
export traces on the CPU), `/api/tts` (its conversion on the device
thread), `/api/separate` (Demucs `.th` or MDX `.onnx`, on the device
thread), `/api/convert_whisper` (diarized conversion with two voice
models alive at once, on the device thread), `/api/audio_edit`
(AudioLDM2 editing, `toy_stack` for the offline stack, on the device
thread), and the network's routes in the handler thread: `/api/download`
(`utils/scrapers.py` `download_any`), `/api/search_models` (HuggingFace)
and `/api/report_bug` (a Discord webhook).  `.onnx` voice models and
embedders convert and extract like `.pth` and `.pt` files, their graphs
run on the server's device (`interop/onnx_run.py`).
A malformed request answers 400, and so does a caller's mistake that
the library's validation finds (`errors.BadRequest`: files that cannot
be combined, an unreadable model); any other fault in the library
answers 500.

Every request runs under torch.inference_mode (grad mode is
thread-local, and each request has its own handler thread).  Conversion
(single and batched) and the warm-up run on one device thread
(`_on_device_thread`): PyTorch keeps cuDNN's execution plans per
thread, so a pipeline called from each new handler thread would build
them again on every request.

Run:  python -m rvc_maker_tpu_torch.app.server --device cuda --port 7865
"""

from __future__ import annotations

import argparse
import base64
import binascii
import html
import io
import itertools
import json
import logging
import os
import re
import threading
import traceback
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from ..device import resolve_device, use_full_fp32
from ..errors import BadRequest
from ..utils.audio import peak_normalize, resample
from ..utils.i18n import (available_languages, catalog, current_language,
                          set_language, tr)

logger = logging.getLogger(__name__)

_STATE: dict = {"pipeline": None, "pipeline_key": None, "device": "cuda"}
_LOCK = threading.Lock()
_JOBS: dict = {}          # id -> {"thread", "log", "done", "error"}
_JOBS_LOCK = threading.Lock()
_DEVICE_THREAD = ThreadPoolExecutor(1, thread_name_prefix="rvc-device")


def _on_device_thread(fn, *args):
    """fn(*args) on the server's one device thread, under inference
    mode; its result or its exception comes back to the caller."""
    def run():
        with torch.inference_mode():
            return fn(*args)

    return _DEVICE_THREAD.submit(run).result()
_JOB_COUNTER = itertools.count()

PRECISIONS = ("bf16", "fp32")
# F0 methods the server runs: it loads RMVPE's weights and no FCPE or CREPE
SERVED_F0 = ("rmvpe", "rmvpe-legacy", "yin", "pyin", "swipe", "pm", "dio", "harvest")
F0_EXTRACT_METHODS = ("yin", "pyin", "swipe", "pm", "dio", "harvest")




INDEX_HTML = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>rvc_maker_tpu</title>
<style>
 body{font-family:system-ui,sans-serif;margin:2rem;max-width:60rem}
 fieldset{margin-bottom:1.5rem;border:1px solid #ccc;border-radius:8px}
 label{display:inline-block;min-width:11rem;margin:.2rem 0}
 input,select{margin:.2rem .5rem .2rem 0}
 button{padding:.4rem 1.2rem;margin-top:.5rem}
 pre{background:#f4f4f4;padding:.8rem;border-radius:6px;overflow:auto}
</style></head><body>
<h1>rvc_maker_tpu</h1>
<fieldset><legend><b>{{convert_audio}}</b></legend>
 <label>{{input_audio}}</label><input type="file" id="c_audio"><br>
 <label>{{model_path}}</label><input id="c_model" size="40"><br>
 <label>{{index_path}}</label><input id="c_index" size="40"><br>
 <label>{{pitch}}</label><input id="c_pitch" type="number" value="0"><br>
 <label>{{index_strength}}</label><input id="c_rate" type="number" step="0.05" value="0.5"><br>
 <label>{{protect}}</label><input id="c_protect" type="number" step="0.01" value="0.33"><br>
 <label>{{f0_method}}</label><select id="c_f0"><option>rmvpe</option><option>yin</option>
   <option>dio</option><option>harvest</option><option>swipe</option></select><br>
 <label>{{rmvpe_path}}</label><input id="c_rmvpe" size="40"><br>
 <label>{{embedder_path}}</label><input id="c_emb" size="40"><br>
 <button onclick="convert()">{{convert_audio}}</button>
 <div id="c_out"></div>
</fieldset>
<fieldset><legend><b>{{modelinfo}}</b></legend>
 <label>{{model_path}}</label><input id="i_model" size="40">
 <button onclick="info()">{{read_model}}</button>
 <pre id="i_out"></pre>
</fieldset>
<fieldset><legend><b>{{audio_effects}}</b></legend>
 <label>{{input_audio}}</label><input type="file" id="e_audio"><br>
 <label>{{reverb}}</label><input id="e_reverb" type="checkbox">
 <label>{{room_size}}</label><input id="e_room" type="number" step="0.05" value="0.5"><br>
 <label>{{pitch}}</label><input id="e_pitch" type="number" value="0"><br>
 <label>{{chorus}}</label><input id="e_chorus" type="checkbox">
 <label>{{delay}}</label><input id="e_delay" type="checkbox">
 <label>{{compressor}}</label><input id="e_comp" type="checkbox">
 <label>{{gain}}</label><input id="e_gain" type="number" value="0"><br>
 <button onclick="effects()">{{apply}}</button>
 <div id="e_out"></div>
</fieldset>
<fieldset><legend><b>{{training_model}}</b></legend>
 <label>{{training_model_name}}</label><input id="t_exp" size="40"><br>
 <label>{{dataset_folder}}</label><input id="t_data" size="40"><br>
 <label>{{sample_rate}}</label><select id="t_sr"><option>48000</option>
   <option>40000</option><option selected>32000</option></select>
 <label>{{training_version}}</label><select id="t_ver"><option selected>v2</option><option>v1</option></select><br>
 <label>{{embedder_path}}</label><input id="t_emb" size="40"><br>
 <label>{{total_epoch}}</label><input id="t_epochs" type="number" value="100">
 <label>{{batch_size}}</label><input id="t_bs" type="number" value="8"><br>
 <label>{{vocoder}}</label><select id="t_voc"><option selected>Default</option>
   <option>MRF HiFi-GAN</option><option>RefineGAN</option></select>
 <label>{{training_pitch}}</label><input id="t_f0" type="checkbox" checked><br>
 <button onclick="job('preprocess')">{{preprocess_button}}</button>
 <button onclick="job('extract')">{{extract_button}}</button>
 <button onclick="job('train')">{{train_button}}</button>
 <button onclick="jobStatus()">{{status}}</button>
 <pre id="t_out"></pre>
</fieldset>
<fieldset><legend><b>{{fushion}}</b></legend>
 <label>{{model_path}} A</label><input id="f_a" size="40"><br>
 <label>{{model_path}} B</label><input id="f_b" size="40"><br>
 <label>{{output_path}}</label><input id="f_out_path" size="40"><br>
 <label>{{model_ratio}}</label><input id="f_ratio" type="number" step="0.05" value="0.5"><br>
 <button onclick="fuse()">{{fushion}}</button>
 <pre id="f_out"></pre>
</fieldset>
<fieldset><legend><b>{{separator_tab}}</b></legend>
 <label>{{input_audio}}</label><input type="file" id="s_audio"><br>
 <label>{{separator_model}}</label><input id="s_model" size="40"><br>
 <label>{{mdx_n_fft}}</label><input id="s_nfft" type="number" value="6144">
 <label>{{hop_length}}</label><input id="s_hop" type="number" value="1024"><br>
 <button onclick="separate()">{{separator_tab}}</button>
 <div id="s_out"></div>
</fieldset>
<fieldset><legend><b>{{pytorch2onnx}}</b></legend>
 <label>{{model_path}}</label><input id="x_model" size="40"><br>
 <label>{{output_path}}</label><input id="x_out_path" size="40"><br>
 <label>{{max_frames}}</label><input id="x_frames" type="number" value="800"><br>
 <button onclick="exportOnnx()">{{pytorch2onnx}}</button>
 <pre id="x_out"></pre>
</fieldset>
<fieldset><legend><b>{{f0_extractor_tab}}</b></legend>
 <label>{{input_audio}}</label><input type="file" id="p_audio"><br>
 <label>{{f0_method}}</label><select id="p_method"><option>yin</option><option>pyin</option>
  <option>swipe</option><option>dio</option><option>harvest</option><option>pm</option></select><br>
 <button onclick="f0Extract()">{{extract_button}}</button>
 <pre id="p_out"></pre>
</fieldset>
<fieldset><legend><b>{{audio_editing}}</b></legend>
 <label>{{audio_path}}</label><input id="a_in" size="40"><br>
 <label>{{output_path}}</label><input id="a_out_path" size="40" value="audios/output.wav"><br>
 <label>{{audioldm2_model}}</label><select id="a_model"><option selected>audioldm2-music</option>
   <option>audioldm2</option><option>audioldm2-large</option></select><br>
 <label>{{source_prompt}}</label><input id="a_src" size="50"><br>
 <label>{{target_prompt}}</label><input id="a_tar" size="50"><br>
 <label>{{steps_label}}</label><input id="a_steps" type="number" value="50">
 <label>t_start (%)</label><input id="a_tstart" type="number" value="45"><br>
 <label>{{cfg_scale_src}}</label><input id="a_cfg_src" type="number" step="0.5" value="3">
 <label>{{cfg_scale_tar}}</label><input id="a_cfg_tar" type="number" step="0.5" value="12"><br>
 <label>{{sample_rate}}</label><input id="a_sr" type="number" value="44100">
 <label>{{export_format}}</label><select id="a_fmt"><option>wav</option><option>flac</option></select><br>
 <button onclick="audioEdit()">{{editing}}</button>
 <pre id="a_out"></pre>
</fieldset>
<fieldset><legend><b>{{convert_text}}</b></legend>
 <label>{{text_to_speech}}</label><input id="y_text" size="50"><br>
 <label>{{voice}}</label><input id="y_voice" size="30" value="en-US-EmmaMultilingualNeural">
 <label>{{googletts}}</label><input id="y_google" type="checkbox"><br>
 <label>{{voice_speed}}</label><input id="y_rate" type="number" value="0">
 <label>{{pitch}}</label><input id="y_pitch" type="number" value="0"><br>
 <label>{{model_path}}</label><input id="y_model" size="40"><br>
 <label>{{embedder_path}}</label><input id="y_emb" size="40">
 <label>{{rmvpe_path}}</label><input id="y_rmvpe" size="30"><br>
 <button onclick="tts()">{{convert_text}}</button>
 <div id="y_out"></div>
</fieldset>
<fieldset><legend><b>{{convert_with_whisper}}</b></legend>
 <label>{{input_audio}}</label><input type="file" id="w_audio"><br>
 <label>{{model_path}} A</label><input id="w_model_a" size="40"><br>
 <label>{{model_path}} B</label><input id="w_model_b" size="40"><br>
 <label>{{ecapa_path}}</label><input id="w_ecapa" size="40"><br>
 <label>{{whisper_path}}</label><input id="w_whisper" size="40">
 <label>{{vocab_path}}</label><input id="w_vocab" size="25"><br>
 <label>{{embedder_path}}</label><input id="w_emb" size="40">
 <label>{{rmvpe_path}}</label><input id="w_rmvpe" size="30"><br>
 <button onclick="convertWhisper()">{{convert_audio}}</button>
 <div id="w_out"></div>
</fieldset>
<fieldset><legend><b>{{createdataset}}</b></legend>
 <label>{{create_dataset_url}}</label><br>
 <textarea id="cd_inputs" rows="3" cols="60"></textarea><br>
 <label>{{output_folder}}</label><input id="cd_out_dir" size="40" value="./dataset">
 <label>{{sample_rate}}</label><input id="cd_sr" type="number" value="44100"><br>
 <label>{{separator_model}}</label><input id="cd_sep" size="40">
 <label>{{clear_dataset}}</label><input id="cd_clean" type="checkbox"><br>
 <button onclick="job2('create_dataset')">{{createdataset}}</button>
 <button onclick="jobStatus2()">{{status}}</button>
 <pre id="cd_out"></pre>
</fieldset>
<fieldset><legend><b>{{downloads}}</b></legend>
 <label>{{download_url}}</label><input id="d_url" size="50"><br>
 <label>{{output_folder}}</label><input id="d_dir" size="40" value="./assets/models"><br>
 <button onclick="download()">{{downloads}}</button>
 <label>{{search_models}}</label><input id="d_query" size="30">
 <button onclick="searchModels()">{{search_2}}</button>
 <pre id="d_out"></pre>
</fieldset>
<fieldset><legend><b>{{settings}}</b></legend>
 <label>{{lang}}</label><select id="g_lang"></select>
 <label>{{precision}}</label><select id="g_prec"><option>bf16</option><option>fp32</option></select>
 <button onclick="saveSettings()">{{apply}}</button>
 <pre id="g_out"></pre>
</fieldset>
<fieldset><legend><b>{{report_bugs}}</b></legend>
 <label>{{webhook_url}}</label><input id="b_hook" size="50"><br>
 <label>{{report_bug_info}}</label><br><textarea id="b_text" rows="3" cols="60"></textarea><br>
 <button onclick="reportBug()">{{report_bugs}}</button>
 <pre id="b_out"></pre>
</fieldset>
<script>
const TR = {{i18n_js}};
async function post(url, body){
  const r = await fetch(url, {method:'POST', headers:{'Content-Type':'application/json'},
                              body: JSON.stringify(body)});
  return r.json();
}
function fileB64(el){ return new Promise((res,rej)=>{
  const f = el.files[0]; if(!f){rej('no file');return;}
  const fr = new FileReader();
  fr.onload = ()=>res(fr.result.split(',')[1]); fr.readAsDataURL(f);
});}
async function convert(){
  document.getElementById('c_out').innerText = TR.processing;
  try{
    const audio = await fileB64(document.getElementById('c_audio'));
    const r = await post('/api/convert', {
      audio_b64: audio,
      model: document.getElementById('c_model').value,
      index: document.getElementById('c_index').value,
      pitch: +document.getElementById('c_pitch').value,
      index_rate: +document.getElementById('c_rate').value,
      protect: +document.getElementById('c_protect').value,
      f0_method: document.getElementById('c_f0').value,
      rmvpe: document.getElementById('c_rmvpe').value,
      embedder: document.getElementById('c_emb').value});
    if(r.error){document.getElementById('c_out').innerText = TR.error_occurred.replace('{e}', r.error); return;}
    const div = document.getElementById('c_out');
    div.innerHTML = '<audio controls src="data:audio/wav;base64,'+r.audio_b64+'"></audio>'
  }catch(e){document.getElementById('c_out').innerText = TR.error_occurred.replace('{e}', e);}
}
async function effects(){
  document.getElementById('e_out').innerText = TR.processing;
  try{
    const audio = await fileB64(document.getElementById('e_audio'));
    const r = await post('/api/effects', {audio_b64: audio,
      reverb: document.getElementById('e_reverb').checked,
      reverb_room_size: +document.getElementById('e_room').value,
      pitchshift: +document.getElementById('e_pitch').value != 0,
      pitch_shift: +document.getElementById('e_pitch').value,
      chorus: document.getElementById('e_chorus').checked,
      delay: document.getElementById('e_delay').checked,
      compressor: document.getElementById('e_comp').checked,
      gain: +document.getElementById('e_gain').value != 0,
      gain_db: +document.getElementById('e_gain').value});
    if(r.error){document.getElementById('e_out').innerText = TR.error_occurred.replace('{e}', r.error); return;}
    document.getElementById('e_out').innerHTML =
      '<audio controls src="data:audio/wav;base64,'+r.audio_b64+'"></audio>';
  }catch(e){document.getElementById('e_out').innerText = TR.error_occurred.replace('{e}', e);}
}
let lastJob = null;
async function job(kind){
  const r = await post('/api/job_start', {kind: kind,
    exp_dir: document.getElementById('t_exp').value,
    dataset: document.getElementById('t_data').value,
    sr: +document.getElementById('t_sr').value,
    version: document.getElementById('t_ver').value,
    embedder: document.getElementById('t_emb').value,
    epochs: +document.getElementById('t_epochs').value,
    batch_size: +document.getElementById('t_bs').value,
    vocoder: document.getElementById('t_voc').value,
    pitch_guidance: document.getElementById('t_f0').checked});
  lastJob = r.job_id;
  document.getElementById('t_out').innerText = JSON.stringify(r, null, 2);
}
async function jobStatus(){
  const r = await post('/api/job_status', {job_id: lastJob});
  document.getElementById('t_out').innerText =
    ('['+(r.done ? TR.done : TR.running)+'] ') + (r.error||'') + '\n' + (r.log||'');
}
async function audioEdit(){
  document.getElementById('a_out').innerText = TR.processing;
  const r = await post('/api/audio_edit', {
    input: document.getElementById('a_in').value,
    output: document.getElementById('a_out_path').value,
    model: document.getElementById('a_model').value,
    source_prompt: document.getElementById('a_src').value,
    target_prompt: document.getElementById('a_tar').value,
    steps: +document.getElementById('a_steps').value,
    t_start: +document.getElementById('a_tstart').value,
    cfg_scale_src: +document.getElementById('a_cfg_src').value,
    cfg_scale_tar: +document.getElementById('a_cfg_tar').value,
    sample_rate: +document.getElementById('a_sr').value,
    export_format: document.getElementById('a_fmt').value});
  document.getElementById('a_out').innerText = JSON.stringify(r, null, 2);
}
async function info(){
  const r = await post('/api/model_info', {model: document.getElementById('i_model').value});
  document.getElementById('i_out').innerText = JSON.stringify(r, null, 2);
}
async function fuse(){
  const r = await post('/api/fuse', {a: document.getElementById('f_a').value,
    b: document.getElementById('f_b').value, out: document.getElementById('f_out_path').value,
    ratio: +document.getElementById('f_ratio').value});
  document.getElementById('f_out').innerText = JSON.stringify(r, null, 2);
}
async function separate(){
  document.getElementById('s_out').innerText = TR.start_separator;
  try{
    const audio = await fileB64(document.getElementById('s_audio'));
    const r = await post('/api/separate', {audio_b64: audio,
      model: document.getElementById('s_model').value,
      mdx_n_fft: +document.getElementById('s_nfft').value,
      mdx_hop: +document.getElementById('s_hop').value});
    if(r.error){document.getElementById('s_out').innerText = TR.error_occurred.replace('{e}', r.error); return;}
    document.getElementById('s_out').innerHTML =
      'vocals: <audio controls src="data:audio/wav;base64,'+r.vocals_b64+'"></audio><br>' +
      'instrumental: <audio controls src="data:audio/wav;base64,'+r.instrumental_b64+'"></audio>';
  }catch(e){document.getElementById('s_out').innerText = TR.error_occurred.replace('{e}', e);}
}
async function exportOnnx(){
  const r = await post('/api/export_onnx', {model: document.getElementById('x_model').value,
    output: document.getElementById('x_out_path').value,
    max_frames: +document.getElementById('x_frames').value});
  document.getElementById('x_out').innerText = JSON.stringify(r, null, 2);
}
async function f0Extract(){
  document.getElementById('p_out').innerText = TR.start_extract;
  try{
    const audio = await fileB64(document.getElementById('p_audio'));
    const r = await post('/api/f0_extract', {audio_b64: audio,
      method: document.getElementById('p_method').value});
    if(r.error){document.getElementById('p_out').innerText = TR.error_occurred.replace('{e}', r.error); return;}
    document.getElementById('p_out').innerText =
      'frames: '+r.f0.length+' (10ms hop)\n'+r.f0.map(x=>x.toFixed(1)).join(' ');
  }catch(e){document.getElementById('p_out').innerText = TR.error_occurred.replace('{e}', e);}
}
async function download(){
  document.getElementById('d_out').innerText = TR.starting_download;
  const r = await post('/api/download', {url: document.getElementById('d_url').value,
    output: document.getElementById('d_dir').value});
  document.getElementById('d_out').innerText = JSON.stringify(r, null, 2);
}
async function searchModels(){
  document.getElementById('d_out').innerText = TR.processing;
  const r = await post('/api/search_models', {query: document.getElementById('d_query').value});
  document.getElementById('d_out').innerText = JSON.stringify(r, null, 2);
}
async function tts(){
  document.getElementById('y_out').innerText = TR.start_tts;
  const r = await post('/api/tts', {text: document.getElementById('y_text').value,
    voice: document.getElementById('y_voice').value,
    google: document.getElementById('y_google').checked,
    rate: +document.getElementById('y_rate').value,
    tts_pitch: +document.getElementById('y_pitch').value,
    model: document.getElementById('y_model').value,
    embedder: document.getElementById('y_emb').value,
    rmvpe: document.getElementById('y_rmvpe').value});
  if(r.error){document.getElementById('y_out').innerText = TR.error_occurred.replace('{e}', r.error); return;}
  let html = 'tts: <audio controls src="data:audio/wav;base64,'+r.audio_b64+'"></audio>';
  if(r.converted_b64) html += '<br>converted: <audio controls src="data:audio/wav;base64,'+r.converted_b64+'"></audio>';
  document.getElementById('y_out').innerHTML = html;
}
async function convertWhisper(){
  document.getElementById('w_out').innerText = TR.processing;
  try{
    const audio = await fileB64(document.getElementById('w_audio'));
    const r = await post('/api/convert_whisper', {audio_b64: audio,
      model_a: document.getElementById('w_model_a').value,
      model_b: document.getElementById('w_model_b').value,
      ecapa: document.getElementById('w_ecapa').value,
      whisper: document.getElementById('w_whisper').value,
      vocab: document.getElementById('w_vocab').value,
      embedder: document.getElementById('w_emb').value,
      rmvpe: document.getElementById('w_rmvpe').value});
    if(r.error){document.getElementById('w_out').innerText = TR.error_occurred.replace('{e}', r.error); return;}
    document.getElementById('w_out').innerHTML =
      '<audio controls src="data:audio/wav;base64,'+r.audio_b64+'"></audio>';
  }catch(e){document.getElementById('w_out').innerText = TR.error_occurred.replace('{e}', e);}
}
let lastJob2 = null;
async function job2(kind){
  const r = await post('/api/job_start', {kind: kind,
    inputs: document.getElementById('cd_inputs').value.split('\\n').filter(x=>x.trim()),
    output: document.getElementById('cd_out_dir').value,
    sr: +document.getElementById('cd_sr').value,
    separator: document.getElementById('cd_sep').value,
    clean: document.getElementById('cd_clean').checked});
  lastJob2 = r.job_id;
  document.getElementById('cd_out').innerText = JSON.stringify(r, null, 2);
}
async function jobStatus2(){
  const r = await post('/api/job_status', {job_id: lastJob2});
  document.getElementById('cd_out').innerText =
    ('['+(r.done ? TR.done : TR.running)+'] ') + (r.error||'') + '\n' + (r.log||'');
}
async function loadSettings(){
  const r = await post('/api/settings', {});
  const sel = document.getElementById('g_lang');
  sel.innerHTML = '';
  for(const l of r.languages){
    const o = document.createElement('option');
    o.text = l; o.selected = (l === r.language); sel.add(o);
  }
  document.getElementById('g_prec').value = r.precision;
}
async function saveSettings(){
  const r = await post('/api/settings', {
    language: document.getElementById('g_lang').value,
    precision: document.getElementById('g_prec').value});
  document.getElementById('g_out').innerText = JSON.stringify(r, null, 2);
}
async function reportBug(){
  document.getElementById('b_out').innerText = TR.processing;
  const r = await post('/api/report_bug', {
    webhook: document.getElementById('b_hook').value,
    text: document.getElementById('b_text').value});
  document.getElementById('b_out').innerText = JSON.stringify(r, null, 2);
}
loadSettings();
</script></body></html>
"""


# keys the page's JS needs for dynamic status/error text
_JS_KEYS = ("processing", "done", "running", "error_occurred",
            "start_separator", "start_extract", "starting_download",
            "start_tts")
_TEMPLATE_RE = re.compile(r"\{\{([a-z0-9_]+)\}\}")


def render_index() -> str:
    """INDEX_HTML with every {{key}} replaced by the active locale's
    string, rendered on the server so that a language change and a
    reload show the whole page translated."""
    js = json.dumps({k: tr(k) for k in _JS_KEYS}, ensure_ascii=False)

    def sub(m):
        key = m.group(1)
        return js if key == "i18n_js" else html.escape(tr(key), quote=False)

    return _TEMPLATE_RE.sub(sub, INDEX_HTML)


def _in_package(module: str, package: str) -> bool:
    return module == package or module.startswith(package + ".")


def _raised_in_library(e: BaseException) -> bool:
    """True when the exception's traceback passes through a module of
    this package outside `app`: a fault of the server's side (a pipeline
    bug, a corrupt model), even if its type is one the 400 classifier
    matches.  Request parsing only runs `app` frames and third-party
    ones (json, base64, scipy's wav reader).  Frames are told apart by
    their module's __name__, not their file's path."""
    for frame, _ in traceback.walk_tb(e.__traceback__):
        name = frame.f_globals.get("__name__", "")
        if (_in_package(name, "rvc_maker_tpu_torch")
                and not _in_package(name, "rvc_maker_tpu_torch.app")):
            return True
    return False


def _wav_bytes_to_audio(data: bytes):
    from scipy.io import wavfile

    sr, wav = wavfile.read(io.BytesIO(data))
    if wav.dtype == np.int16:
        wav = wav.astype(np.float32) / 32768.0
    elif wav.dtype == np.int32:
        wav = wav.astype(np.float32) / 2147483648.0
    else:
        wav = wav.astype(np.float32)
    if wav.ndim == 2:
        wav = wav.mean(axis=1)
    return wav, sr


def _audio_to_wav_b64(audio: np.ndarray, sr: int) -> str:
    from scipy.io import wavfile

    buf = io.BytesIO()
    wavfile.write(buf, sr, (np.clip(audio, -1, 1) * 32767).astype(np.int16))
    return base64.b64encode(buf.getvalue()).decode()


def _request_audio(req: dict) -> np.ndarray:
    """The request's base64 WAV as float32 at 16 kHz; empty audio is a
    malformed request."""
    wav, sr = _wav_bytes_to_audio(base64.b64decode(req["audio_b64"]))
    if wav.size == 0:
        raise ValueError("the request's audio is empty")
    return resample(wav, sr, 16000).astype(np.float32)


def _int_field(req: dict, key: str, default: int) -> int:
    v = req.get(key, default)
    if isinstance(v, bool) or not isinstance(v, (int, str)) or not re.fullmatch(
            r"[+-]?\d+", str(v).strip()):
        raise ValueError(f"{key} must be an integer, got {v!r}")
    return int(v)


def _f0_method(req: dict) -> str:
    """The request's F0 method, checked against those the server runs;
    rmvpe without an rmvpe path falls back to yin, as the JAX server's."""
    from ..pipelines.convert import f0_members

    method = req.get("f0_method", "rmvpe")
    if not isinstance(method, str):
        raise ValueError(f"f0_method must be a string, got {method!r}")
    if method == "rmvpe" and not req.get("rmvpe"):
        return "yin"
    for m in f0_members(method):
        if m not in SERVED_F0:
            raise ValueError(f"unknown f0 method {m!r}: the server runs "
                             f"{', '.join(SERVED_F0)} and hybrid[...] of them")
        if m.startswith("rmvpe") and not req.get("rmvpe"):
            raise ValueError(f"f0 method {m!r} needs an rmvpe path")
    return method


def set_device(device) -> torch.device:
    """The device the server's pipelines and jobs run on; a card that is
    not there raises.  On the card, fp32 runs without TF32 from here on
    (`device.use_full_fp32`)."""
    _STATE["device"] = resolve_device(device)
    use_full_fp32(_STATE["device"])
    return _STATE["device"]


def _load_hubert(path: str):
    """An embedder path: a transformers directory, a fairseq .pt or a
    `.onnx` embedder (on the server's device); none gives random weights
    from seed 0 (as the JAX server's `init_params(PRNGKey(0))`, though
    not the same draws)."""
    from ..models.hubert import load_hubert_pt, load_transformers_dir

    if not path:
        from ..interop import from_jax

        return from_jax.hubert_from_jax(from_jax.random_hubert_tree(seed=0))
    if path.endswith(".onnx"):
        from ..interop.onnx_embedder import OnnxEmbedder

        return OnnxEmbedder(path, device=_STATE["device"])
    return load_transformers_dir(path) if os.path.isdir(path) else load_hubert_pt(path)


def _build_pipeline(model: str, index: str, rmvpe: str, embedder: str,
                    precision: str = "fp32"):
    """A pipeline of these files on the server's device, outside the
    resident slot."""
    from ..interop.onnx_voice import load_voice_model
    from ..models.rmvpe import load_rmvpe_pt
    from ..pipelines.convert import ConvertPipeline
    from ..retrieval.index import load_index

    device = _STATE["device"]
    # a .pth gives a params tree, a .onnx an OnnxVoiceModel on the device
    synth_params, cfg, meta = load_voice_model(model, device=device)
    return ConvertPipeline(
        synth_params, cfg, _load_hubert(embedder), version=meta.get("version", "v2"),
        rmvpe_params=load_rmvpe_pt(rmvpe) if rmvpe else None,
        index_vectors=load_index(index).vectors if index else None, device=device,
        compute_dtype=torch.bfloat16 if precision == "bf16" else None)


def _get_pipeline(model: str, index: str, rmvpe: str, embedder: str):
    """The resident pipeline of these files, in the settings' precision
    on the server's device; one slot, keyed by all of them."""
    precision = _SETTINGS.get("precision", "bf16")
    key = (model, index, rmvpe, embedder, precision, str(_STATE["device"]))
    with _LOCK:
        if _STATE["pipeline_key"] == key:
            return _STATE["pipeline"]
    pipe = _build_pipeline(model, index, rmvpe, embedder, precision)
    with _LOCK:
        _STATE["pipeline"] = pipe
        _STATE["pipeline_key"] = key
    return pipe


def _conversion(req: dict):
    """A conversion request's (pipeline, speaker id, settings): its
    files' resident pipeline, and sid, pitch, index_rate, protect and
    f0_method checked.  A sid the model does not have is a malformed
    request."""
    from ..pipelines.convert import ConvertSettings

    f0_method = _f0_method(req)
    sid = _int_field(req, "sid", 0)
    settings = ConvertSettings(pitch=_int_field(req, "pitch", 0),
                               index_rate=float(req.get("index_rate", 0.5)),
                               protect=float(req.get("protect", 0.33)), f0_method=f0_method)
    pipe = _get_pipeline(req["model"], req.get("index", ""), req.get("rmvpe", ""),
                         req.get("embedder", ""))
    if not 0 <= sid < pipe.cfg.spk_embed_dim:
        raise ValueError(f"sid {sid} out of range: the model has "
                         f"{pipe.cfg.spk_embed_dim} speakers")
    return pipe, sid, settings


def _get_batcher(pipe):
    with _LOCK:
        if _STATE.get("batcher_pipe") is not pipe:
            if _STATE.get("batcher") is not None:
                _STATE["batcher"].close()
            from .batcher import ConvertBatcher

            _STATE["batcher"] = ConvertBatcher(pipe, run=_on_device_thread)
            _STATE["batcher_pipe"] = pipe
        return _STATE["batcher"]


class Handler(BaseHTTPRequestHandler):
    def _json(self, obj, code=200):
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        if self.path in ("/", "/index.html"):
            body = render_index().encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/html; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        elif self.path == "/api/i18n":
            self._json({"language": current_language(), "strings": catalog()})
        else:
            self._json({"error": tr("not_found", name=self.path)}, 404)

    def do_POST(self):
        routes = {"/api/convert": self._api_convert,
                  "/api/f0_extract": self._api_f0_extract,
                  "/api/job_start": lambda req: self._json(_start_job(req)),
                  "/api/job_status": self._api_job_status,
                  "/api/settings": self._api_settings,
                  "/api/effects": self._api_effects,
                  "/api/model_info": self._api_model_info,
                  "/api/fuse": self._api_fuse,
                  "/api/export_onnx": self._api_export_onnx,
                  "/api/tts": self._api_tts,
                  "/api/separate": self._api_separate,
                  "/api/convert_whisper": self._api_convert_whisper,
                  "/api/audio_edit": self._api_audio_edit,
                  "/api/download": self._api_download,
                  "/api/search_models": lambda req: self._json(
                      {"models": _search_hf_models(req["query"])}),
                  "/api/report_bug": lambda req: self._json(
                      _report_bug(req["webhook"], req["text"]))}
        try:
            n = int(self.headers.get("Content-Length", "0"))
            req = json.loads(self.rfile.read(n) or b"{}")
            if not isinstance(req, dict):
                raise ValueError("the request body must be a JSON object")
            if self.path not in routes:
                self._json({"error": tr("not_found", name=self.path)}, 404)
                return
            with torch.inference_mode():
                routes[self.path](req)
        except Exception as e:  # noqa: BLE001 — every error answers the client
            self._error(e)

    def _error(self, e: Exception):
        from .batcher import BatcherOverloaded

        if isinstance(e, BatcherOverloaded):
            # backpressure: the client retries, the server keeps serving
            self._json({"error": str(e), "retry": True}, 503)
        elif isinstance(e, BadRequest) or (
                isinstance(e, (KeyError, ValueError, TypeError, binascii.Error,
                               json.JSONDecodeError)) and not _raised_in_library(e)):
            # a malformed request, raised while app/ parses it, or a
            # mistake the library's validation found
            logger.warning("%s", tr("bad_request", path=self.path, error=repr(e)))
            self._json({"error": tr("bad_request", path=self.path, error=str(e))}, 400)
        else:
            logger.exception("request failed")
            self._json({"error": str(e)}, 500)

    def _api_convert(self, req):
        # while a training job owns the card, conversion is refused with
        # 503 and a retry; RVC_TPU_SERVE_DURING_TRAIN=1 opts into sharing
        if os.environ.get("RVC_TPU_SERVE_DURING_TRAIN", "0") != "1":
            with _JOBS_LOCK:
                busy = [j for j_id, j in _JOBS.items()
                        if j_id.startswith("train-") and not j["done"]]
            if busy:
                self._json({"error": tr("busy_training"), "retry": True}, 503)
                return
        audio16 = peak_normalize(_request_audio(req))
        pipe, sid, settings = _conversion(req)
        if os.environ.get("RVC_TPU_BATCH_SERVE") == "1":
            out = _get_batcher(pipe).convert(audio16, sid, settings)
        else:
            out = _on_device_thread(pipe.convert_utterance, audio16, sid, settings)
        self._json({"audio_b64": _audio_to_wav_b64(out, pipe.cfg.sr), "sr": pipe.cfg.sr})

    def _api_f0_extract(self, req):
        from ..pipelines.convert import WINDOW

        audio16 = _request_audio(req)
        method = req.get("method", "yin")
        if method not in F0_EXTRACT_METHODS:
            raise ValueError(f"unknown f0 method {method!r}: "
                             f"f0_extract runs {', '.join(F0_EXTRACT_METHODS)}")
        if method == "yin":
            from ..f0.yin import yin

            x = torch.as_tensor(audio16[None], device=_STATE["device"])
            f0 = yin(x, sr=16000, fmin=50.0, fmax=1100.0, hop_length=WINDOW)[0].cpu().numpy()
        elif method == "pyin":
            from ..f0.pyin import pyin

            f0 = pyin(audio16, 16000, hop_length=WINDOW)[0]
        elif method == "swipe":
            from ..f0.swipe import swipe

            f0 = swipe(audio16, 16000)[0]
        elif method == "pm":
            from ..f0.praat_ac import praat_ac

            f0 = praat_ac(audio16, 16000)
        else:
            from ..f0 import world

            fn = world.dio if method == "dio" else world.harvest
            f0 = fn(audio16.astype(np.float64), 16000)[0]
        self._json({"f0": [float(x) for x in np.asarray(f0).ravel()], "hop_ms": 10.0})

    def _api_effects(self, req):
        """The effects chain on the request's WAV (JAX server.py:759-770)."""
        import dataclasses

        from ..utils.effects import EffectsSettings, apply_effects

        wav, sr = _wav_bytes_to_audio(base64.b64decode(req["audio_b64"]))
        fields = {f.name for f in dataclasses.fields(EffectsSettings)}
        settings = EffectsSettings(**{k: v for k, v in req.items() if k in fields})
        out, out_sr = apply_effects(wav, sr, settings)
        self._json({"audio_b64": _audio_to_wav_b64(out, out_sr), "sr": out_sr})

    def _api_model_info(self, req):
        from ..utils.model_tools import model_info

        self._json(model_info(req["model"]))

    def _api_fuse(self, req):
        from ..utils.model_tools import fuse_models

        self._json({"output": fuse_models(req["a"], req["b"], req["out"],
                                          ratio=float(req.get("ratio", 0.5)))})

    def _api_download(self, req):
        """A model file from a URL (Google Drive, MediaFire, mega.nz,
        pixeldrain, HuggingFace or any other) into req["output"], host
        work in the handler thread (JAX server.py:603-606)."""
        from ..utils.scrapers import download_any

        self._json({"output": download_any(req["url"], req.get("output", "."))})

    def _api_export_onnx(self, req):
        from ..interop.onnx_voice import export_voice_model

        model, output = req["model"], req["output"]
        if not os.path.isfile(model):
            raise ValueError(f"no such model file {model!r}")
        out = export_voice_model(model, output, max_frames=_int_field(req, "max_frames", 800),
                                 dynamic=not req.get("static", False))
        self._json({"output": out})

    def _api_tts(self, req):
        """Synthesize (the Edge read-aloud protocol, or Google's with
        "google"), and with "model" convert the speech as /api/convert
        does, on the device thread (JAX server.py:772-812)."""
        import tempfile

        from ..utils import edge_tts_client as etc
        from ..utils.tts import _read_tts_output, synthesize_tts

        google = bool(req.get("google"))
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "tts.wav")
            synthesize_tts(req["text"], req.get("voice", etc.DEFAULT_VOICE), path,
                           rate=_int_field(req, "rate", 0),
                           pitch=_int_field(req, "tts_pitch", 0), google=google,
                           endpoint=req.get("endpoint"),
                           output_format=None if google else etc.PCM_FORMAT)
            audio24 = _read_tts_output(path, 24000)
        resp = {"audio_b64": _audio_to_wav_b64(audio24, 24000), "sr": 24000}
        if req.get("model"):
            audio16 = peak_normalize(resample(audio24, 24000, 16000))
            pipe, sid, settings = _conversion(req)
            out = _on_device_thread(pipe.convert_utterance, audio16, sid, settings)
            resp.update(converted_b64=_audio_to_wav_b64(out, pipe.cfg.sr),
                        converted_sr=pipe.cfg.sr)
        self._json(resp)

    def _api_separate(self, req):
        """Vocals and instrumental of the request's WAV (made stereo), each
        averaged back to mono in the response, with a Demucs `.th` at its
        own rate or an MDX `.onnx` at the input's, on the device thread
        (JAX server.py:693-718)."""
        wav, sr = _wav_bytes_to_audio(base64.b64decode(req["audio_b64"]))
        if wav.size == 0:
            raise ValueError("the request's audio is empty")
        model = req["model"]
        if not os.path.isfile(model):
            raise ValueError(f"no such model file {model!r}")
        n_fft, hop = _int_field(req, "mdx_n_fft", 6144), _int_field(req, "mdx_hop", 1024)
        device = _STATE["device"]

        def run():
            if model.endswith(".onnx"):
                from ..interop.onnx_run import OnnxGraph
                from ..pipelines import mdx as mdx_mod

                graph = OnnxGraph(model, device=device)
                p = mdx_mod.params_from_graph(graph, n_fft=n_fft, hop_length=hop)
                vocals, inst = mdx_mod.mdx_separate(graph, np.stack([wav, wav]), p)
                return vocals, inst, sr
            from ..interop.demucs_load import load_demucs_th
            from ..pipelines.separate import separate_vocals

            params, cfg = load_demucs_th(model, device=device)
            vocals, inst = separate_vocals(params, cfg, wav, sr)      # each (L, 2)
            return vocals.T, inst.T, cfg.samplerate

        vocals, inst, out_sr = _on_device_thread(run)
        self._json({"vocals_b64": _audio_to_wav_b64(vocals.mean(0), out_sr),
                    "instrumental_b64": _audio_to_wav_b64(inst.mean(0), out_sr),
                    "sr": out_sr})

    def _api_convert_whisper(self, req):
        """Diarized two-model conversion (JAX server.py:836-872): Whisper
        segments (with "whisper" and "vocab") or an energy VAD, the
        segments' ECAPA embeddings clustered, each converted by its
        cluster's voice model.  Both pipelines are built for the request
        in fp32, as the JAX server builds them, and everything runs on the
        device thread."""
        from ..pipelines.convert import ConvertSettings

        audio16 = _request_audio(req)
        settings = ConvertSettings(pitch=_int_field(req, "pitch", 0),
                                   index_rate=float(req.get("index_rate", 0.5)),
                                   protect=float(req.get("protect", 0.33)),
                                   f0_method=_f0_method(req))
        models = [m for m in (req.get("model_a"), req.get("model_b")) if m]
        if not models:
            raise ValueError("need at least model_a")
        files = [*models, req["ecapa"]] + (
            [req["whisper"], req.get("vocab", "")] if req.get("whisper") else [])
        for path in files:
            if not isinstance(path, str) or not os.path.exists(path):
                raise ValueError(f"no such file {path!r}")

        def run():
            from ..speaker.diarize import convert_with_diarization
            from ..speaker.hyperyaml import load_ecapa

            device = _STATE["device"]
            pipes = [_build_pipeline(m, req.get("index", ""), req.get("rmvpe", ""),
                                     req.get("embedder", "")) for m in models]
            whisper = None
            if req.get("whisper"):
                from ..models.whisper import load_whisper_pt
                from ..speaker.whisper_tokenizer import WhisperTokenizer

                whisper = (load_whisper_pt(req["whisper"], device=device),
                           WhisperTokenizer(req["vocab"], multilingual=True))
            out = convert_with_diarization(audio16, pipes, [settings] * len(pipes),
                                           load_ecapa(req["ecapa"], device), whisper=whisper)
            return out, pipes[0].cfg.sr

        out, sr = _on_device_thread(run)
        self._json({"audio_b64": _audio_to_wav_b64(out, sr), "sr": sr})

    def _api_audio_edit(self, req):
        """Prompt-based audio editing (JAX server.py:814-838): the
        request's input file edited and written to its "output", on the
        device thread, with the toy latent stack when "toy_stack" is set
        (the AudioLDM2 checkpoint is not in the repository; without it
        the loader raises, as JAX's does)."""
        src = req["input"]
        if not isinstance(src, str) or not os.path.isfile(src):
            raise ValueError(f"no such input file {src!r}")
        kw = dict(model_id=req.get("model", "audioldm2-music"),
                  source_prompt=req.get("source_prompt", ""),
                  target_prompt=req.get("target_prompt", ""), steps=_int_field(req, "steps", 50),
                  cfg_scale_src=float(req.get("cfg_scale_src", 3.5)),
                  cfg_scale_tar=float(req.get("cfg_scale_tar", 12.0)),
                  t_start=_int_field(req, "t_start", 45), sr=_int_field(req, "sample_rate", 44100),
                  export_format=req.get("export_format", "wav"))
        device = _STATE["device"]

        def run():
            from ..edit.pipeline import ToyMelStack, edit

            stack = ToyMelStack(device=device) if req.get("toy_stack") else None
            return edit(src, req.get("output", "audios/output.wav"), stack=stack, device=device,
                        **kw)

        self._json({"output": _on_device_thread(run)})

    def _api_job_status(self, req):
        with _JOBS_LOCK:
            job = _JOBS.get(req.get("job_id"))
        if job is None:
            self._json({"error": tr("not_found", name=req.get("job_id"))}, 404)
        else:
            self._json({"done": job["done"], "error": job["error"],
                        "log": "\n".join(job["log"][-40:])})

    def _api_settings(self, req):
        """Settings apply live and persist to SETTINGS_PATH."""
        lang, precision = req.get("language"), req.get("precision")
        if precision and precision not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
        if lang and lang not in available_languages():
            raise ValueError(f"unknown language {lang!r}")
        if lang or precision:
            if lang:
                set_language(lang)
                _SETTINGS["language"] = lang
            if precision:
                _SETTINGS["precision"] = precision
            _save_settings()
        self._json({"language": _SETTINGS.get("language", "en-US"),
                    "precision": _SETTINGS.get("precision", "bf16"),
                    "languages": available_languages()})

    def log_message(self, fmt, *args):  # route to logging, not stderr
        logger.info("%s " + fmt, self.address_string(), *args)


# the port's own settings file, so that its server and the JAX package's
# never rewrite each other's
SETTINGS_PATH = os.path.expanduser("~/.rvc_maker_tpu_torch.json")
_SETTINGS: dict = {}


def _load_settings() -> None:
    """Apply the persisted settings (language, precision); `serve` reads
    them when it starts."""
    try:
        with open(SETTINGS_PATH, encoding="utf-8") as f:
            _SETTINGS.update(json.load(f))
    except (OSError, ValueError):
        return
    if _SETTINGS.get("language"):
        set_language(_SETTINGS["language"])


def _save_settings() -> None:
    try:
        with open(SETTINGS_PATH, "w", encoding="utf-8") as f:
            json.dump(_SETTINGS, f, indent=2)
    except OSError:
        logger.warning("%s", tr("settings_persist_failed", path=SETTINGS_PATH))


def _start_job(req: dict) -> dict:
    """Run a training-stage job (preprocess, extract, train) in a
    background thread on the server's device, its log captured for
    /api/job_status.  The job thread runs with grad mode on (its own)."""
    kind = req.get("kind")
    if kind not in ("preprocess", "extract", "train", "create_dataset"):
        raise ValueError(f"unknown job kind {kind!r}")
    if kind == "create_dataset":
        inputs = req["inputs"]
        if not isinstance(inputs, list) or not all(isinstance(i, str) for i in inputs):
            raise ValueError("inputs must be a list of paths or URLs")
        sr = _int_field(req, "sr", 44100)
    else:
        exp_dir = req["exp_dir"]
        version = req.get("version", "v2")
        sr = _int_field(req, "sr", 32000)
    if kind == "preprocess":
        dataset = req["dataset"]
        num_workers = _int_field(req, "num_workers", 2)
    elif kind == "extract":
        embedder = req.get("embedder", "")
    else:
        vocoder = req.get("vocoder", "Default")
        if vocoder not in ("Default", "MRF HiFi-GAN", "MRF-HiFi-GAN", "RefineGAN"):
            raise ValueError(f"unknown vocoder {vocoder!r}")
        pitch_guidance = bool(req.get("pitch_guidance", True))
        epochs = _int_field(req, "epochs", 100)
        batch_size = _int_field(req, "batch_size", 8)
    device = _STATE["device"]
    with _JOBS_LOCK:
        job_id = f"{kind}-{next(_JOB_COUNTER)}"
        job = {"log": [], "done": False, "error": None}
        _JOBS[job_id] = job

    class _Buf(logging.Handler):
        def emit(self, record):
            job["log"].append(self.format(record))

    def _run():
        handler = _Buf()
        handler.setFormatter(logging.Formatter("%(asctime)s %(message)s"))
        root = logging.getLogger("rvc_maker_tpu_torch")
        root.addHandler(handler)
        try:
            if kind == "create_dataset":
                from ..pipelines.create_dataset import create_dataset

                separator = None
                if req.get("separator"):
                    from ..interop.demucs_load import load_demucs_th

                    separator = load_demucs_th(req["separator"], device=device)
                written = create_dataset(inputs, req.get("output", "./dataset"), sample_rate=sr,
                                         separator=separator,
                                         clean_dataset=bool(req.get("clean")), device=device)
                job["log"].append(f"create_dataset: {len(written)} files")
            elif kind == "preprocess":
                from ..pipelines.preprocess import preprocess_dataset

                n = preprocess_dataset(dataset, exp_dir, sr, num_workers=num_workers)
                job["log"].append(f"preprocess: {n} segments")
            elif kind == "extract":
                from ..config import preset
                from ..models.rmvpe import load_rmvpe_pt
                from ..pipelines import extract as ex

                hubert = _load_hubert(embedder)
                # without an rmvpe path the f0 comes from yin (JAX server.py:1037-1046)
                rmvpe = load_rmvpe_pt(req["rmvpe"]) if req.get("rmvpe") else None
                ex.extract_f0(exp_dir, rmvpe, method="rmvpe" if rmvpe else "yin",
                              device=device)
                ex.extract_embeddings(exp_dir, hubert, version=version, device=device)
                cfg = preset(version, sr)
                ex.write_mute_fixture(exp_dir, cfg, hubert, version, device=device)
                ex.generate_filelist(exp_dir, cfg, version)
                job["log"].append("extract: done")
            else:
                from ..config import preset
                from ..pipelines.train_loop import train

                cfg = preset(version, sr, vocoder=vocoder, pitch_guidance=pitch_guidance)
                train(exp_dir, cfg, total_epochs=epochs,
                      batch_size=batch_size, pretrain_g=req.get("pretrain_g", ""),
                      pretrain_d=req.get("pretrain_d", ""), device=device)
                job["log"].append("train: done")
        except Exception as e:  # noqa: BLE001 — surfaced through /api/job_status
            logger.exception("job %s failed", job_id)
            job["error"] = str(e)
        finally:
            job["done"] = True
            root.removeHandler(handler)

    t = threading.Thread(target=_run, daemon=True, name=job_id)
    job["thread"] = t
    t.start()
    return {"job_id": job_id}


def _search_hf_models(query: str, limit: int = 20) -> list[dict]:
    """HuggingFace model search (JAX server.py:946-957; reference
    search_models app.py:327-348): the network."""
    import urllib.parse
    import urllib.request

    url = ("https://huggingface.co/api/models?search=" + urllib.parse.quote(query)
           + f"&limit={limit}")
    with urllib.request.urlopen(url, timeout=15) as resp:
        items = json.loads(resp.read().decode())
    return [{"id": it.get("id"), "downloads": it.get("downloads"), "likes": it.get("likes")}
            for it in items]


def _report_bug(webhook_url: str, text: str) -> dict:
    """A bug report to a Discord webhook (JAX server.py:960-975; reference
    report-bugs tab, app.py:1400): the network."""
    import urllib.request

    if not webhook_url.startswith("https://"):
        raise ValueError("webhook must be an https URL")
    data = json.dumps({"content": text[:1900]}).encode()
    req = urllib.request.Request(webhook_url, data=data,
                                 headers={"Content-Type": "application/json",
                                          "User-Agent": "rvc_maker_tpu_torch"})
    with urllib.request.urlopen(req, timeout=15) as resp:
        return {"status": resp.status}


def warm(model: str, index: str = "", rmvpe: str = "", embedder: str = "",
         buckets: str = "3,5") -> float:
    """Build the serving pipeline and run its bucket shapes before
    accepting traffic (`utils/warmup.py`).  buckets: a comma list of
    seconds, or 'BxS' for batch x seconds.  Returns the wall seconds."""
    from ..utils.warmup import parse_warm_spec, warm_pipeline

    pipe = _get_pipeline(model, index, rmvpe, embedder)
    spec = parse_warm_spec(buckets) or [(1, 3)]
    # on the device thread, whose cuDNN plans the requests then reuse
    return _on_device_thread(lambda: sum(warm_pipeline(pipe, seconds=(s,), batches=(b,))
                                         for b, s in spec))


def serve(host: str = "0.0.0.0", port: int = 7865, *, device="cuda",
          warm_model: str = "", warm_index: str = "", warm_rmvpe: str = "",
          warm_embedder: str = "", warm_buckets: str = "3,5"):
    """Serve on host:port until interrupted; device "cuda" raises
    without a card."""
    set_device(device)
    _load_settings()
    if warm_model:
        logger.info("%s", tr("warming_up", model=warm_model))
        dt = warm(warm_model, warm_index, warm_rmvpe, warm_embedder, warm_buckets)
        logger.info("%s", tr("warmup_done", seconds=f"{dt:.1f}"))
    httpd = ThreadingHTTPServer((host, port), Handler)
    logger.info("%s", tr("serving_on", url=f"http://{host}:{port}"))
    httpd.serve_forever()


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=7865)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--warm-model", default="",
                    help="run this voice model's serving shapes before serving")
    ap.add_argument("--warm-index", default="")
    ap.add_argument("--warm-rmvpe", default="")
    ap.add_argument("--warm-embedder", default="")
    ap.add_argument("--warm-buckets", default="3,5",
                    help="bucket seconds to warm, e.g. '3,5' or '4x3'")
    a = ap.parse_args()
    logging.basicConfig(level=logging.INFO)
    serve(a.host, a.port, device=a.device, warm_model=a.warm_model,
          warm_index=a.warm_index, warm_rmvpe=a.warm_rmvpe,
          warm_embedder=a.warm_embedder, warm_buckets=a.warm_buckets)
