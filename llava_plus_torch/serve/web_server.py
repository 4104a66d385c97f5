"""Web chat UI + HTTP API (gradio-free).

Replaces the reference's ``gradio_web_server.py`` / ``_llava_plus.py`` UIs
with a self-contained aiohttp app. Feature parity with the reference
interaction surface:

- token streaming to the browser (ref ``http_bot`` yields per chunk,
  gradio_web_server_llava_plus.py:460-487) — chunks are written as the
  worker produces them, not buffered;
- sketch-mask visual prompt: draw on the uploaded image, the mask's bbox is
  appended as ``Input box: [x0,y0,x1,y1]`` (ref :39-97, :327-334);
- SEEM reference image + mask capture (ref :336-342, :541-546);
- "Prog" debug toggle showing the raw round-1 thoughts/actions (ref
  :286-298) and tool-output folding in the transcript (ref
  conversation.py merge_output :258-371);
- image process mode Crop/Resize/Pad/Default (ref gradio_web_server.py:327)
  and vote/flag buttons (ref :240-249);
- server-side sessions: ``ToolSession`` persists across turns keyed by a
  client session id, so segment-then-inpaint works across turns (the
  reference caches mask state on the conversation, ref :560-596).

Conversation/vote logs keep the reference's JSONL audit format
(ref gradio_web_server_llava_plus.py:726-737).

The port's own copy of ``llava_plus_tpu/serve/web_server.py``.
"""

from __future__ import annotations

import argparse
import base64
import datetime
import json
import os
import threading
import time
import uuid
from io import BytesIO

from llava_plus_torch.constants import LOGDIR
from llava_plus_torch.conversation import conv_templates, expand2square_rgb
from llava_plus_torch.serve.orchestrator import (
    ToolOrchestrator,
    ToolSession,
    get_mask_bbox,
    get_worker_addr,
)
from llava_plus_torch.utils.logging import build_logger

logger = build_logger("web_server", "web_server.log")

SESSION_TTL_S = 3600
MAX_SESSIONS = 1024

INDEX_HTML = """<!doctype html>
<html><head><meta charset="utf-8"><title>LLaVA-Plus</title>
<style>
 body{font-family:system-ui,sans-serif;max-width:900px;margin:24px auto;padding:0 12px}
 #chat{border:1px solid #ccc;border-radius:8px;min-height:320px;padding:12px;
       white-space:pre-wrap;overflow-y:auto;max-height:55vh}
 .u{color:#125;font-weight:600;margin-top:8px}.a{color:#161;margin:4px 0}
 .status{color:#888;font-style:italic;font-size:13px}
 .prog{background:#f6f2e8;border:1px dashed #caa;border-radius:6px;
       padding:6px;margin:4px 0;font-size:12px;white-space:pre-wrap}
 details.tool{background:#eef4ee;border-radius:6px;padding:4px 8px;margin:4px 0;
       font-size:12px} details.tool pre{white-space:pre-wrap;margin:4px 0}
 .row{display:flex;gap:8px;margin-top:10px}
 textarea{flex:1;height:60px} button{padding:6px 14px}
 img.result{max-width:320px;display:block;margin:6px 0;border-radius:6px}
 .ctl{display:flex;gap:14px;align-items:center;margin:8px 0;font-size:13px;
      flex-wrap:wrap}
 .sketchbox{position:relative;display:inline-block;margin:4px 0}
 .sketchbox canvas{position:absolute;left:0;top:0;cursor:crosshair}
 .sketchbox img{display:block;max-width:320px}
 .votes button{font-size:12px;padding:3px 8px}
</style></head><body>
<h2>LLaVA-Plus <small>(PyTorch)</small></h2>
<div class="ctl">
 <label>Model <select id="model"></select></label>
 <label>Temp <input id="temp" type="range" min="0" max="1" step="0.1" value="0.2">
  <span id="tempv">0.2</span></label>
 <label>Top-p <input id="topp" type="range" min="0" max="1" step="0.05" value="0.7">
  <span id="toppv">0.7</span></label>
 <label>Image mode <select id="imode">
  <option>Default</option><option>Crop</option><option>Resize</option><option>Pad</option>
 </select></label>
 <label><input id="prog" type="checkbox"> Prog</label>
</div>
<div class="ctl">
 <label>Image <input id="img" type="file" accept="image/*"></label>
 <button id="clearSketch" style="display:none">Clear sketch</button>
 <label>Reference image (SEEM) <input id="refimg" type="file" accept="image/*"></label>
 <button id="clearRefSketch" style="display:none">Clear ref sketch</button>
</div>
<div id="imgbox" class="sketchbox"></div>
<div id="refbox" class="sketchbox"></div>
<div id="chat"></div>
<div class="ctl" id="examples"><span>Examples:</span></div>
<div class="row"><textarea id="msg" placeholder="Ask about the image... (draw on it to add a box prompt)"></textarea>
<button id="send">Send</button><button id="clear">Clear</button></div>
<div class="ctl votes">
 <button data-vote="upvote">&#128077; Upvote</button>
 <button data-vote="downvote">&#128078; Downvote</button>
 <button data-vote="flag">&#9872; Flag</button>
 <button id="regen">&#128260; Regenerate</button>
</div>
<script>
const chat = document.getElementById('chat');
let history = [];
let lastAnswer = '';
const sessionId = (crypto.randomUUID ? crypto.randomUUID()
                   : String(Math.random()).slice(2));
temp.oninput = () => tempv.textContent = temp.value;
topp.oninput = () => toppv.textContent = topp.value;
fetch('/api/models', {method:'POST'}).then(r=>r.json()).then(d=>{
  for (const m of d.models) { const o=document.createElement('option');
    o.textContent=m; model.appendChild(o); }
});
function setImageFromB64(b64){
  const bytes = Uint8Array.from(atob(b64), c=>c.charCodeAt(0));
  const f = new File([bytes], 'example.png', {type:'image/png'});
  const dt = new DataTransfer(); dt.items.add(f);
  img.files = dt.files;
  img.dispatchEvent(new Event('change'));
}
fetch('/api/examples', {method:'POST'}).then(r=>r.json()).then(d=>{
  const row = document.getElementById('examples');
  d.examples.forEach((ex, i)=>{
    const b=document.createElement('button');
    b.textContent='Example '+(i+1);
    b.title=ex.text;
    b.onclick=()=>{ setImageFromB64(ex.image); msg.value=ex.text; };
    row.appendChild(b);
  });
});
function add(cls, text){const d=document.createElement('div');d.className=cls;
  d.textContent=text;chat.appendChild(d);chat.scrollTop=chat.scrollHeight;return d;}
async function fileB64(f){return new Promise(res=>{const r=new FileReader();
  r.onload=()=>res(r.result.split(',')[1]);r.readAsDataURL(f);});}

// --- sketch canvases (visual box prompt + SEEM reference mask) ----------
function makeSketch(boxId, inputEl, clearBtn) {
  const box = document.getElementById(boxId);
  const state = {canvas: null, drawn: false, img: null};
  inputEl.addEventListener('change', async () => {
    box.innerHTML = ''; state.drawn = false; state.canvas = null;
    if (!inputEl.files[0]) { clearBtn.style.display='none'; return; }
    const url = URL.createObjectURL(inputEl.files[0]);
    const im = new Image();
    im.onload = () => {
      const w = Math.min(320, im.naturalWidth);
      const h = Math.round(im.naturalHeight * w / im.naturalWidth);
      im.width = w; im.height = h;
      const cv = document.createElement('canvas');
      cv.width = w; cv.height = h;
      box.appendChild(im); box.appendChild(cv);
      const ctx = cv.getContext('2d');
      ctx.strokeStyle = '#fff'; ctx.lineWidth = 12; ctx.lineCap = 'round';
      let draw = false, px = 0, py = 0;
      cv.onpointerdown = e => {draw = true; px = e.offsetX; py = e.offsetY;};
      cv.onpointermove = e => { if (!draw) return;
        ctx.beginPath(); ctx.moveTo(px, py); ctx.lineTo(e.offsetX, e.offsetY);
        ctx.stroke(); px = e.offsetX; py = e.offsetY; state.drawn = true; };
      cv.onpointerup = cv.onpointerleave = () => draw = false;
      state.canvas = cv; state.img = im;
      clearBtn.style.display = '';
    };
    im.src = url;
  });
  clearBtn.onclick = () => { if (!state.canvas) return;
    state.canvas.getContext('2d').clearRect(0, 0, state.canvas.width,
                                            state.canvas.height);
    state.drawn = false; };
  state.maskB64 = () => state.drawn
    ? state.canvas.toDataURL('image/png').split(',')[1] : null;
  return state;
}
const sketch = makeSketch('imgbox', img, clearSketch);
const refSketch = makeSketch('refbox', refimg, clearRefSketch);

async function run(text) {
  const body = {model: model.value, text, history, session_id: sessionId,
    temperature: parseFloat(temp.value), top_p: parseFloat(topp.value),
    image_process_mode: imode.value};
  if (img.files[0]) body.image = await fileB64(img.files[0]);
  const m = sketch.maskB64(); if (m) body.sketch_mask = m;
  if (refimg.files[0]) {
    body.reference_image = await fileB64(refimg.files[0]);
    const rm = refSketch.maskB64(); if (rm) body.reference_mask = rm;
  }
  const out = add('a','...');
  let statusEl = null;
  const resp = await fetch('/api/chat', {method:'POST',
    headers:{'Content-Type':'application/json'}, body: JSON.stringify(body)});
  const reader = resp.body.getReader(); const dec = new TextDecoder();
  let buf='';
  for(;;){const {done,value} = await reader.read(); if(done) break;
    buf += dec.decode(value,{stream:true});
    const parts = buf.split('\\0'); buf = parts.pop();
    for(const p of parts){ if(!p) continue; const d = JSON.parse(p);
      if(d.text !== undefined){ out.textContent = d.text; lastAnswer = d.text; }
      if(d.status){ if(!statusEl) statusEl = add('status','');
        statusEl.textContent = d.status; }
      if(d.prog && prog.checked){ const pd=document.createElement('div');
        pd.className='prog'; pd.textContent=d.prog;
        chat.insertBefore(pd, out); }
      if(d.tool){ const det=document.createElement('details');
        det.className='tool';
        // build via DOM, never innerHTML: api_name is model-generated
        // text (prompt-injectable) and must not be parsed as HTML
        const sum=document.createElement('summary');
        sum.textContent = d.tool.api_name + ' output';
        const pre=document.createElement('pre');
        pre.textContent = JSON.stringify(d.tool.response, null, 1);
        det.appendChild(sum); det.appendChild(pre);
        chat.insertBefore(det, out); }
      if(d.image){const im=document.createElement('img');im.className='result';
        im.src='data:image/png;base64,'+d.image;chat.appendChild(im);}
      if(d.error_code){ out.textContent = d.text || ('error '+d.error_code); }
      chat.scrollTop = chat.scrollHeight;
    }}
  history.push([text, out.textContent]);
}
send.onclick = () => {
  const text = msg.value.trim(); if(!text) return;
  msg.value=''; add('u','You: '+text); run(text);
};
// Regenerate: pop the last assistant turn (and any tool/status bubbles
// rendered for it) and re-stream the same user message, keeping the
// session's tool state (ref gradio_web_server.py:113-120, :355, :384).
regen.onclick = () => {
  if (!history.length) return;
  const text = history.pop()[0];
  while (chat.lastChild && chat.lastChild.className !== 'u')
    chat.removeChild(chat.lastChild);
  run(text);
};
clear.onclick = () => {chat.innerHTML=''; history=[]; img.value=''; refimg.value='';
  document.getElementById('imgbox').innerHTML='';
  document.getElementById('refbox').innerHTML='';
  fetch('/api/reset', {method:'POST', headers:{'Content-Type':'application/json'},
    body: JSON.stringify({session_id: sessionId})});};
document.querySelectorAll('.votes button').forEach(b => b.onclick = () =>
  fetch('/api/vote', {method:'POST', headers:{'Content-Type':'application/json'},
    body: JSON.stringify({type: b.dataset.vote, model: model.value,
                          text: lastAnswer, session_id: sessionId})}));
</script></body></html>"""


def log_conversation(kind: str, payload: dict):
    os.makedirs(LOGDIR, exist_ok=True)
    name = datetime.datetime.now().strftime("%Y-%m-%d") + "-conv.json"
    with open(os.path.join(LOGDIR, name), "a") as f:
        f.write(json.dumps({"tstamp": time.time(), "type": kind, **payload}) + "\n")


class SessionStore:
    """Server-side per-conversation tool state: the reference caches
    mask_rle / image_seg / reference image on the gradio conversation state
    across turns (ref gradio_web_server_llava_plus.py:560-596); here the
    browser holds a session id and the ToolSession lives server-side."""

    def __init__(self, ttl_s: float = SESSION_TTL_S, cap: int = MAX_SESSIONS):
        self._lock = threading.Lock()
        self._sessions: dict = {}
        self.ttl_s = ttl_s
        self.cap = cap

    def get(self, session_id: str) -> ToolSession:
        now = time.time()
        with self._lock:
            # prune
            dead = [k for k, (_, ts) in self._sessions.items()
                    if now - ts > self.ttl_s]
            for k in dead:
                del self._sessions[k]
            # Remove the requested id BEFORE eviction: the active session
            # must never be the eviction victim (it would silently lose its
            # ToolSession mask/segmentation state mid-conversation).
            sess, _ = self._sessions.pop(session_id, (None, None))
            while len(self._sessions) >= self.cap:
                oldest = min(self._sessions, key=lambda k: self._sessions[k][1])
                del self._sessions[oldest]
            if sess is None:
                sess = ToolSession()
            self._sessions[session_id] = (sess, now)
            return sess

    def reset(self, session_id: str):
        with self._lock:
            self._sessions.pop(session_id, None)


def _decode_image(b64: str):
    from PIL import Image

    return Image.open(BytesIO(base64.b64decode(b64))).convert("RGB")


def _apply_process_mode(image, mode: str):
    """Image process mode selector (ref gradio_web_server.py:327 radio +
    conversation.get_images resize modes)."""
    if image is None or mode in (None, "Default", "Raw+Processor"):
        return image
    if mode == "Pad":
        return expand2square_rgb(image)
    if mode == "Crop":
        side = min(image.size)
        left = (image.width - side) // 2
        top = (image.height - side) // 2
        return image.crop((left, top, left + side, top + side))
    if mode == "Resize":
        return image.resize((336, 336))
    raise ValueError(f"Invalid image_process_mode: {mode}")


def _example_prompts():
    """Two demo (image, prompt) pairs, mirroring the reference UI's
    gr.Examples (gradio_web_server.py:333-336). The reference bundles
    photographs; here the images are drawn procedurally
    (utils/demo_assets.py) so the repo stays binary-free — the point is
    the one-click demo flow, not the pixels."""
    from llava_plus_torch.utils.demo_assets import demo_image_b64

    return [
        {"image": demo_image_b64("unusual"),
         "text": "What is unusual about this image?"},
        {"image": demo_image_b64("waterview"),
         "text": "What are the things I should be cautious about "
                 "when I visit here?"},
    ]


def build_app(controller_addr: str, llava_plus: bool = False,
              conv_mode: str = "v1", moderate: bool = False):
    import asyncio

    from aiohttp import web

    orch = ToolOrchestrator(controller_addr)
    sessions = SessionStore()

    routes = web.RouteTableDef()

    @routes.get("/")
    async def index(request):
        return web.Response(text=INDEX_HTML, content_type="text/html")

    @routes.post("/api/examples")
    async def examples(request):
        return web.json_response({"examples": _example_prompts()})

    @routes.post("/api/models")
    async def models(request):
        import requests as rq

        try:
            r = rq.post(controller_addr + "/list_models", timeout=5)
            return web.json_response({"models": sorted(r.json()["models"])})
        except Exception:
            return web.json_response({"models": []})

    def _turn_events(data: dict):
        """Blocking generator of wire chunks for one chat turn (runs on a
        worker thread; the async handler streams each chunk as produced)."""
        conv = conv_templates[conv_mode].copy()
        for u, a in data.get("history", []):
            conv.append_message(conv.roles[0], u)
            conv.append_message(conv.roles[1], a)

        text = data["text"]
        image = None
        if data.get("image"):
            image = _apply_process_mode(
                _decode_image(data["image"]),
                data.get("image_process_mode", "Default"),
            )

        # sketch-mask visual prompt -> "Input box: [...]" (ref :327-334)
        if data.get("sketch_mask"):
            from PIL import Image as PILImage

            mask = PILImage.open(BytesIO(base64.b64decode(data["sketch_mask"])))
            bbox = get_mask_bbox(mask)
            if bbox is not None:
                text = text + f"\nInput box: {bbox}"

        session = sessions.get(data.get("session_id") or uuid.uuid4().hex)
        # SEEM reference image/mask capture (ref :336-342)
        if data.get("reference_image"):
            session.reference_image = data["reference_image"]
            session.reference_mask = data.get("reference_mask")

        gen_params = dict(
            temperature=data.get("temperature", 0.2),
            top_p=data.get("top_p", 0.7),
            max_new_tokens=data.get("max_new_tokens", 512),
            stop=conv.sep2 or conv.sep,
        )
        try:
            if llava_plus:
                for ev in orch.stream_turn(
                    conv, data["model"], text, image=image,
                    session=session, **gen_params,
                ):
                    if "text" in ev:
                        yield {"text": ev["text"]}
                    elif "status" in ev:
                        yield {"status": ev["status"]}
                    elif "prog" in ev:
                        yield {"prog": ev["prog"]}
                    elif "tool_response" in ev:
                        yield {"tool": {"api_name": ev["api_name"],
                                        "response": ev["tool_response"]}}
                    elif "image" in ev:
                        yield {"image": ev["image"]}
                    elif "error" in ev:
                        yield {"status": f"tool error: {ev['error']}"}
            else:
                if image is not None and not data.get("history"):
                    text = "<image>\n" + text
                conv.append_message(conv.roles[0], text)
                conv.append_message(conv.roles[1], None)
                image_b64 = None
                if image is not None:
                    buf = BytesIO()
                    image.save(buf, format="PNG")
                    image_b64 = base64.b64encode(buf.getvalue()).decode()
                for chunk in orch.stream_model(
                    data["model"], conv.get_prompt(),
                    [image_b64] if image_b64 else None, **gen_params,
                ):
                    yield {"text": chunk}
            log_conversation("chat", {
                "model": data.get("model"), "text": data.get("text"),
                "session": data.get("session_id"),
            })
        except Exception as e:
            logger.error(f"chat turn failed: {e}")
            yield {"text": f"error: {e}", "error_code": 1}

    @routes.post("/api/chat")
    async def chat(request):
        data = await request.json()
        if moderate:
            from llava_plus_torch.utils.logging import moderation_msg
            from llava_plus_torch.utils.misc import violates_moderation

            if violates_moderation(data.get("text", "")):
                log_conversation("flagged", {"text": data.get("text", "")})
                return web.json_response({"error": moderation_msg})
        resp = web.StreamResponse()
        await resp.prepare(request)
        loop = asyncio.get_event_loop()
        queue: asyncio.Queue = asyncio.Queue()

        def produce():
            try:
                for chunk in _turn_events(data):
                    loop.call_soon_threadsafe(queue.put_nowait, chunk)
            finally:
                loop.call_soon_threadsafe(queue.put_nowait, None)

        producer = loop.run_in_executor(None, produce)
        while True:
            chunk = await queue.get()
            if chunk is None:
                break
            await resp.write(json.dumps(chunk).encode() + b"\0")
        await producer
        await resp.write_eof()
        return resp

    @routes.post("/api/reset")
    async def reset(request):
        data = await request.json()
        if data.get("session_id"):
            sessions.reset(data["session_id"])
        return web.json_response({})

    @routes.post("/api/vote")
    async def vote(request):
        data = await request.json()
        log_conversation(data.get("type", "vote"), data)
        return web.json_response({})

    app = web.Application(client_max_size=64 * 1024 * 1024)
    app.add_routes(routes)
    return app


def main():
    from aiohttp import web

    parser = argparse.ArgumentParser()
    parser.add_argument("--host", type=str, default="0.0.0.0")
    parser.add_argument("--port", type=int, default=7860)
    parser.add_argument("--controller-url", type=str,
                        default="http://localhost:21001")
    parser.add_argument("--llava-plus", action="store_true",
                        help="enable the tool-use orchestration loop")
    parser.add_argument("--conv-mode", type=str, default="v1")
    parser.add_argument("--moderate", action="store_true",
                        help="gate user input through the OpenAI moderation "
                             "endpoint (ref gradio_web_server --moderate)")
    args = parser.parse_args()
    logger.info(f"args: {args}")
    web.run_app(
        build_app(args.controller_url, args.llava_plus, args.conv_mode,
                  moderate=args.moderate),
        host=args.host, port=args.port,
    )


if __name__ == "__main__":
    main()
